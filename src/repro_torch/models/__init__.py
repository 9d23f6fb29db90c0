"""The model stack on the port: shared blocks (``common``), GQA
attention on the flash and paged attention kernels (``attention``), the
dense MLP and the MoE layers (``ffn``), RWKV6 on the WKV6 kernel
(``rwkv``), the Mamba mixer on the SSD kernel (``mamba``) and the
``LM`` of the dense, RWKV6 and hybrid families (``model``)."""

from .model import LM, build_model

__all__ = ["LM", "build_model"]
