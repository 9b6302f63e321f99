"""Host data layer: key files, waveform files, the 'dir' fetcher and its
directory index, synthetic data (namesake of detex_tpu/data, on rows and
the standard library instead of pandas)."""
from detex_torch.data import keys, waveio
from detex_torch.data.keys import readKey

__all__ = ["keys", "waveio", "readKey"]
