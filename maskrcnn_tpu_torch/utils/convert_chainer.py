"""Chainer npz → the port's weights (its converters are a numpy-only copy of
``maskrcnn_tpu/utils/convert_chainer.py``).

Spec: the reference backbone loads ImageNet-pretrained chainer
``ResNet50Layers('auto')`` weights (reference feature_pyramid_network.py:22,
c4_backbone.py:9) and publishes a Light-Head checkpoint as npz
(README.md:57-62). This converter maps those npz trees onto this framework's
flax parameter layout so pretrained-parity experiments are possible
(SURVEY §7 hard-part 5).

Layout conversions:
- chainer Convolution2D ``W`` is (O, I, kH, kW) → flax kernel (kH, kW, I, O),
- chainer Linear ``W`` is (out, in) → flax kernel (in, out); when the linear
  consumed a flattened NCHW conv map, the input dim is additionally permuted
  CHW → HWC to match this framework's NHWC flatten order,
- BatchNormalization gamma/beta/avg_mean/avg_var →
  BatchNorm scale/bias (params) + mean/var (batch_stats).

chainer ResNet block naming: stage ``res{k}`` has block ``a`` (with
projection conv4/bn4) and blocks ``b1..bN`` → our ``res{k}/block{i}`` with
``Conv_0..2`` + ``proj``.

The port composes them with the flax bridge: chainer npz → flax-layout
trees (``convert_full_npz``, ``convert_resnet50_npz``) → the port's
``state_dict`` keys and layouts, leaf by leaf
(``utils/convert_flax.py``). :func:`load_pretrained_npz` loads loosely, as
JAX's ``load_pretrained`` does (reference ``load_npz(strict=False)``): the
tensors the npz has are overwritten, the initialisation stays elsewhere,
and a shape mismatch raises.
"""

from __future__ import annotations

import numpy as np
import torch

from maskrcnn_tpu_torch.utils.convert_flax import _convert, _flatten, _torch_key


def _conv(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))


def _linear(w: np.ndarray, chw: tuple[int, int, int] | None = None) -> np.ndarray:
    # chainer (out, in) → flax (in, out); optionally re-order the flattened
    # input from CHW to HWC.
    if chw is not None:
        c, h, wd = chw
        out = w.shape[0]
        w = w.reshape(out, c, h, wd).transpose(0, 2, 3, 1).reshape(out, -1)
    return w.T


def convert_resnet50_npz(npz: dict, prefix: str = "") -> tuple[dict, dict]:
    """Convert a chainer ResNet50Layers npz → (params, batch_stats) subtrees
    matching ``maskrcnn_tpu.models.backbones.resnet.ResNet50``."""
    params: dict = {}
    stats: dict = {}

    def get(name):
        return npz[prefix + name]

    def put_bn(pdst: dict, sdst: dict, cname: str):
        pdst["BatchNorm_0"] = {
            "scale": get(f"{cname}/gamma"),
            "bias": get(f"{cname}/beta"),
        }
        sdst["BatchNorm_0"] = {
            "mean": get(f"{cname}/avg_mean"),
            "var": get(f"{cname}/avg_var"),
        }

    # stem present only in full backbones — gate on conv1 AND bn1: the res5
    # head owns an unrelated ``conv1`` (3×3, resnet_roi_mask_head.py:31)
    # under the same prefix, so conv1/W alone is ambiguous
    if f"{prefix}conv1/W" in npz and f"{prefix}bn1/gamma" in npz:
        params["conv1"] = {"kernel": _conv(get("conv1/W"))}
        params["bn1"], stats["bn1"] = {}, {}
        put_bn(params["bn1"], stats["bn1"], "bn1")

    stage_blocks = {"res2": 3, "res3": 4, "res4": 6, "res5": 3}
    for stage, n in stage_blocks.items():
        if f"{prefix}{stage}/a/conv1/W" not in npz:
            continue  # truncated models (C4) lack res5
        sp, ss = {}, {}
        for i in range(n):
            cname = "a" if i == 0 else f"b{i}"
            bp, bs = {}, {}
            for j in range(3):
                bp[f"Conv_{j}"] = {"kernel": _conv(get(f"{stage}/{cname}/conv{j + 1}/W"))}
                bp[f"Norm_{j}"], bs[f"Norm_{j}"] = {}, {}
                put_bn(bp[f"Norm_{j}"], bs[f"Norm_{j}"], f"{stage}/{cname}/bn{j + 1}")
            if i == 0:
                bp["proj"] = {"kernel": _conv(get(f"{stage}/a/conv4/W"))}
                bp["proj_bn"], bs["proj_bn"] = {}, {}
                put_bn(bp["proj_bn"], bs["proj_bn"], f"{stage}/a/bn4")
            sp[f"block{i}"] = bp
            ss[f"block{i}"] = bs
        params[stage] = sp
        stats[stage] = ss
    return params, stats


def _deconv(w: np.ndarray) -> np.ndarray:
    # chainer Deconvolution2D W is (in, out, kH, kW) → flax ConvTranspose
    # kernel (kH, kW, in, out) **spatially flipped**: chainer deconv scatters
    # out[s·i+di] += x[i]·W[..., di] while flax/lax conv_transpose convolves
    # the dilated input with an un-mirrored kernel (impulse-response
    # verified in tests/test_convert.py::test_deconv_forward_parity).
    return np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1))[::-1, ::-1])


def _conv_params(npz, name: str, use_bias: bool = True) -> dict:
    out = {"kernel": _conv(npz[f"{name}/W"])}
    if use_bias and f"{name}/b" in npz:
        out["bias"] = npz[f"{name}/b"]
    return out


def _linear_params(npz, name: str, chw=None) -> dict:
    out = {"kernel": _linear(npz[f"{name}/W"], chw)}
    if f"{name}/b" in npz:
        out["bias"] = npz[f"{name}/b"]
    return out


def _deconv_params(npz, name: str) -> dict:
    out = {"kernel": _deconv(npz[f"{name}/W"])}
    if f"{name}/b" in npz:
        out["bias"] = npz[f"{name}/b"]
    return out


def _darknet_backbone(npz, prefix: str) -> tuple[dict, dict]:
    """Reference Darknet (model/extractor/darknet.py:19-60): 5 ConvBatch
    chains named conv1..conv5, each with inner conv ``c`` + ``bn``."""
    params, stats = {}, {}
    for i in range(1, 6):
        cname = f"{prefix}conv{i}"
        bn_p = {"scale": npz[f"{cname}/bn/gamma"],
                "bias": npz[f"{cname}/bn/beta"]}
        bn_s = {"mean": npz[f"{cname}/bn/avg_mean"],
                "var": npz[f"{cname}/bn/avg_var"]}
        params[f"conv{i}"] = {
            "Conv_0": _conv_params(npz, f"{cname}/c"),
            "Norm_0": {"BatchNorm_0": bn_p},
        }
        stats[f"conv{i}"] = {"Norm_0": {"BatchNorm_0": bn_s}}
    return params, stats


def convert_extractor(npz, backbone: str) -> tuple[dict, dict]:
    """Backbone/neck subtree of a serialized full model.

    chainer attribute layout (= npz key paths):
    - fpn: ``extractor/resnet/...`` + toplayer/conv_p*/lat_p* 1×1/3×3 convs
      (reference feature_pyramid_network.py:19-44),
    - c4: ``extractor`` IS a ResNet50Layers subclass, so resnet keys sit
      directly under ``extractor/`` (c4_backbone.py:7-15),
    - darknet: ConvBatch chains (darknet.py:30-38).
    """
    if backbone == "fpn":
        params, stats = {}, {}
        rp, rs = convert_resnet50_npz(npz, prefix="extractor/resnet/")
        params["resnet"], stats["resnet"] = rp, rs
        for name in ("toplayer", "conv_p2", "conv_p3", "conv_p4", "conv_p6",
                     "lat_p2", "lat_p3", "lat_p4"):
            params[name] = _conv_params(npz, f"extractor/{name}")
        return params, stats
    if backbone == "c4":
        rp, rs = convert_resnet50_npz(npz, prefix="extractor/")
        return {"resnet": rp}, {"resnet": rs}
    if backbone == "darknet":
        return _darknet_backbone(npz, "extractor/")
    raise ValueError(f"unknown backbone {backbone!r}")


def convert_rpn(npz) -> dict:
    """RPN head (reference multilevel_region_proposal_network.py:84-88).

    Channel semantics carry over exactly: chainer's NCHW
    ``transpose(0,2,3,1).reshape(n,-1,4)`` equals our NHWC
    ``reshape(b,-1,4)``, so a plain (O,I,kh,kw)→(kh,kw,I,O) transpose keeps
    the anchor-innermost output ordering bit-compatible."""
    return {name: _conv_params(npz, f"rpn/{name}")
            for name in ("conv", "score", "loc")}


def convert_head(npz, head: str, n_mask_convs: int = 8) -> tuple[dict, dict]:
    """ROI head subtree. Returns (params, batch_stats) — stats only non-empty
    for the res5 head (its BN blocks)."""
    p: dict = {}
    s: dict = {}
    if head in ("fpn", "fpn_keypoint"):
        # box branch (reference fpn_roi_mask_head.py:24-29): fc1 consumes the
        # flattened 7×7×256 conv1 output → CHW→HWC permute on its input dim.
        p["box"] = {
            "conv1": _conv_params(npz, "head/conv1"),
            "fc1": _linear_params(npz, "head/fc1", chw=(256, 7, 7)),
            "fc2": _linear_params(npz, "head/fc2"),
            "cls_loc": _linear_params(npz, "head/cls_loc"),
            "score": _linear_params(npz, "head/score"),
        }
        mask: dict = {}
        if head == "fpn":
            for i in range(1, 5):
                mask[f"mask{i}"] = _conv_params(npz, f"head/mask{i}")
            mask["deconv1"] = _deconv_params(npz, "head/deconv1")
            # our MaskBranch stores the final 1×1 conv as explicit
            # (c_in, n_out) kernel + bias (class-gathered evaluation)
            w = npz["head/conv2/W"]  # (n_out, c_in, 1, 1)
            mask["conv2_kernel"] = w[:, :, 0, 0].T
            mask["conv2_bias"] = npz["head/conv2/b"]
        else:
            # keypoint head: ChainList mask_convs/0..N-1
            # (fpn_roi_keypoint_head.py:34-38)
            for i in range(n_mask_convs):
                mask[f"mask{i + 1}"] = _conv_params(npz, f"head/mask_convs/{i}")
            mask["deconv1"] = _deconv_params(npz, "head/deconv1")
            mask["conv2"] = _conv_params(npz, "head/conv2")
        p["mask"] = mask
    elif head == "light":
        # light_roi_mask_head.py:30-75 — note the trailing underscores on
        # conv3_ / deconv1_ in the reference.
        p["thin"] = {name: _conv_params(npz, f"head/{name}")
                     for name in ("conv_ul", "conv_bl", "conv_ur", "conv_br")}
        p["fc"] = _linear_params(npz, "head/fc", chw=(490, 7, 7))
        p["cls_loc"] = _linear_params(npz, "head/cls_loc")
        p["score"] = _linear_params(npz, "head/score")
        p["conv2"] = _conv_params(npz, "head/conv2")
        p["conv3"] = _conv_params(npz, "head/conv3_")
        p["conv4"] = _conv_params(npz, "head/conv4")
        p["deconv1"] = _deconv_params(npz, "head/deconv1_")
    elif head == "res5":
        # resnet_roi_mask_head.py:25-50 — res5 block + conv1 + GAP heads.
        rp, rs = convert_resnet50_npz(npz, prefix="head/")
        p["res5"] = {"res5": rp["res5"]}
        s["res5"] = {"res5": rs["res5"]}
        p["conv1"] = _conv_params(npz, "head/conv1")
        # GAP output is channels-only → no CHW permute on the linears.
        p["cls_loc"] = _linear_params(npz, "head/cls_loc")
        p["score"] = _linear_params(npz, "head/score")
        p["deconv1"] = _deconv_params(npz, "head/deconv1")
        p["conv2"] = _conv_params(npz, "head/conv2")
    else:
        raise ValueError(f"unknown head {head!r}")
    return p, s


def convert_full_npz(npz: dict, backbone: str, head: str,
                     n_mask_convs: int = 8) -> tuple[dict, dict]:
    """Convert a serialized full reference model (``save_npz`` of the
    MaskRCNN chain, reference train.py:135) → (params, batch_stats) trees
    matching :class:`maskrcnn_tpu.models.MaskRCNN`."""
    ep, es = convert_extractor(npz, backbone)
    hp, hs = convert_head(npz, head, n_mask_convs)
    params = {"extractor": ep, "rpn_head": convert_rpn(npz), "head": hp}
    stats: dict = {"extractor": es}
    if hs:
        stats["head"] = hs
    return params, stats


def is_full_model_npz(npz: dict) -> bool:
    """True for a serialized MaskRCNN (extractor/rpn/head paths), False for
    a bare ResNet50Layers ImageNet npz (conv1/W at the root)."""
    return any(k.startswith("rpn/") for k in npz)


def load_npz(path: str) -> dict:
    return dict(np.load(path, allow_pickle=False))


def convert_npz(npz: dict, backbone: str, head: str,
                n_mask_convs: int = 8) -> tuple[dict, str]:
    """A chainer npz → (flax-layout ``{"params", "batch_stats"}`` tree, what
    it holds): a full serialized model, or a bare ImageNet
    ``ResNet50Layers`` npz (the backbone's ResNet only)."""
    if is_full_model_npz(npz):
        params, stats = convert_full_npz(npz, backbone, head, n_mask_convs)
        return ({"params": params, "batch_stats": stats},
                f"full {backbone}/{head} model")
    rp, rs = convert_resnet50_npz(npz)
    return ({"params": {"extractor": {"resnet": rp}},
             "batch_stats": {"extractor": {"resnet": rs}}},
            "ImageNet ResNet-50 backbone")


@torch.no_grad()
def load_pretrained_npz(model: torch.nn.Module, npz_path: str, backbone: str,
                        head: str, n_mask_convs: int = 8,
                        verbose: bool = True) -> tuple[int, int]:
    """Load a chainer npz into ``model`` in place, loosely: every tensor of
    the npz whose port key ``model`` has overwrites it (after the bridge's
    layout change), the rest of ``model`` keeps its initialisation, and a
    shape mismatch raises → (parameter tensors, statistic tensors) loaded."""
    tree, what = convert_npz(load_npz(npz_path), backbone, head, n_mask_convs)
    target = model.state_dict()
    loaded = {"params": 0, "batch_stats": 0}
    for path, x in _flatten(tree):
        key = _torch_key(path)
        if key not in target:
            continue
        y = np.ascontiguousarray(_convert(path, x))
        if tuple(y.shape) != tuple(target[key].shape):
            raise ValueError(f"{'/'.join(path)} → {key}: converted shape "
                             f"{y.shape} != target {tuple(target[key].shape)}")
        target[key].copy_(torch.from_numpy(y.astype(np.float32)))
        loaded[path[0]] += 1
    if verbose:
        print(f"initialized {what} from {npz_path}: {loaded['params']} param "
              f"+ {loaded['batch_stats']} stat tensors loaded")
    return loaded["params"], loaded["batch_stats"]
