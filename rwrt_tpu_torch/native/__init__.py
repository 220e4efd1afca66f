"""Host-side native code: the C++ polynomial root solver (``cpolyroots.cpp``,
built at first use by ``build.py``)."""
