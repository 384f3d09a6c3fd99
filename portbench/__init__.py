"""The benchmark of ``tsim_tpu_torch`` on NVIDIA cards (see README.md)."""
