"""Data parallelism: one process per GPU over ``torch.distributed``."""
