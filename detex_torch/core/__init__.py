"""Host primitives of the detection engine: UTC time, Trace / Stream
containers and the scipy filters (copies of detex_tpu/core's, which the
port cannot import: detex_tpu's package imports JAX)."""
from detex_torch.core.utc import UTCDateTime
from detex_torch.core.stream import Stats, Stream, Trace
from detex_torch.core import filters

__all__ = ["UTCDateTime", "Stats", "Stream", "Trace", "filters"]
