"""Hand-written CUDA kernels of detex_torch (sources ``*.cu``/``*.cuh``), the
nvcc build step that compiles them (``build.py``) and a host build of the
kernel bodies for checking them without a GPU (``emulation/``)."""
