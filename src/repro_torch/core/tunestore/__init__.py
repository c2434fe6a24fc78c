"""Persistent warm start (DESIGN.md §13), feeding the aggregation
executor's ``BucketCostModel``:

* :class:`TuneStore`: the on-disk table of what a tuned process knows
  (cost tables, ladders, inner chunks, strategy selections), so process
  two measures nothing; the kernels' build cache
  (``repro_torch.kernels._build``) already keeps it from rebuilding;
* :class:`RooflinePrior`: the analytical first contact, so an empty store
  still gives a sane ladder without timing any launch.
"""
from repro_torch.core.tunestore.prior import (
    DEVICE_PEAKS, RooflinePrior, device_peaks,
)
from repro_torch.core.tunestore.store import (
    SCHEMA_VERSION, STORE_ENV_VAR, TuneStore, TuneStoreWarning, code_salt,
    entry_key,
)

__all__ = [
    "DEVICE_PEAKS", "RooflinePrior", "device_peaks",
    "SCHEMA_VERSION", "STORE_ENV_VAR", "TuneStore", "TuneStoreWarning",
    "code_salt", "entry_key",
]
