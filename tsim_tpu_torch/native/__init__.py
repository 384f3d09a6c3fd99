"""Native (C++) runtime kernels, built lazily with g++ + ctypes."""
