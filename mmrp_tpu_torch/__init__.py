"""mmrp_tpu_torch — the serving slice of ``mmrp_tpu`` in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

Module for module the counterpart of ``mmrp_tpu``: ``models`` (Swin, BERT,
fusion, the multimodal hub), ``ops`` (the fused kernels of the serving route —
window attention, LN + MLP, sequence attention and the whole Swin block in its
windows / raw / chain / pair flavors — and their plain-PyTorch versions),
``retrieval.gallery`` (exact cosine top-K), ``utils.convert`` (Flax
parameters -> state dict, seeded init) and ``api`` (``serving_forward``,
``MMRPredictor``).

The package imports torch and numpy only: no JAX, Flax, PyYAML or
``mmrp_tpu``. CUDA kernels build at first use (``ops._build``), and the entry
points build on the card unless given ``device="cpu"``.
"""

__version__ = "0.1.0"


def __getattr__(name):  # lazy, like mmrp_tpu: a bare import loads no model code
    if name == "MMRPredictor":
        from mmrp_tpu_torch.api import MMRPredictor

        return MMRPredictor
    raise AttributeError(name)
