"""The model stack on the port: shared blocks (``common``), GQA
attention on the flash and paged attention kernels (``attention``), the
dense MLP (``ffn``) and the dense-family ``LM`` (``model``)."""

from .model import LM, build_model

__all__ = ["LM", "build_model"]
