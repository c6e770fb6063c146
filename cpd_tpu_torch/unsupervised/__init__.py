"""Unsupervised pseudo-label factory (port of cpd_tpu/unsupervised).

Parity with cpd/unsupervised_core/ (reference __init__.py:1-28): initial-label
generators {DBSCAN, OYSTER, MFCF} and refiners {C_PROTO}, dispatched per
sequence by ``compute_outline_box`` with idempotent pkl caching. The stages
are host-side NumPy/SciPy, as in the JAX package, except the two neighbour
searches: PPScore's radius count (kernel R1, ``ops/radius.py``) and DBSCAN
(kernel R2, ``ops/dbscan.py``) run on the CUDA card.
"""
from .driver import compute_outline_box, ALL_INIT, ALL_REFINE  # noqa: F401
