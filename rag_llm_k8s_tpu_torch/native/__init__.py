"""The port's C++ host libraries (``bpe.cpp``, ``indexio.cpp``), built with
``g++`` at first use and loaded with ctypes (``build.load_library``)."""
