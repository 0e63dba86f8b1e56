"""The port's host C++ codec source (bls_host.cpp) and the generator of its
constants.h (gen_constants.py); native_codec.py builds and loads them."""
