"""LPT sequence packing and the synthetic LM stream (numpy copies of
``repro.data``)."""
from .packing import lpt_pack, pack_documents  # noqa: F401
from .pipeline import synthetic_lm_batches  # noqa: F401
