"""Multi-device execution: meshes of devices and sharded PIV (port of :mod:`pyorc_tpu.parallel`).

The reference is a single-node CPU code base (dask threads + numba, reference
``pyorc/velocimetry/ffpiv.py:140``); its parallelism axis, independent frame
pairs, maps onto a 1-D mesh of devices (:mod:`.piv`). Ensemble correlation
averaging adds the shards' accumulators on one device, the only reduction
across devices the pipeline needs. Across processes and hosts,
:mod:`.distributed` coordinates through ``torch.distributed`` (gloo) and
moves no frames. Importing this package starts no process group.
"""

from . import distributed
from .piv import make_mesh, piv_ensemble_sharded, piv_multipass_sharded, piv_pairs_sharded, piv_pairs_sharded_2d

__all__ = [
    "make_mesh",
    "piv_pairs_sharded",
    "piv_ensemble_sharded",
    "piv_multipass_sharded",
    "piv_pairs_sharded_2d",
    "distributed",
]
