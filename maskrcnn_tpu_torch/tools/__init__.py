"""Offline tools of the port: rescoring a results file, timing the loader."""
