"""Native (C and CUDA) code of the port: the host replay engine
(replay.c), the quantity parser's and the TLV wire codec's CPython
extensions (_kquantity.c, _ktlv.c), copies of kubernetes_tpu/native/'s,
and build.py, which compiles them and the CUDA kernels under csrc/ on
first use. Importing the package builds and loads _kquantity, as the JAX
package's does; where it cannot, api/resource.py parses quantities in
Python."""

from kubernetes_tpu_torch.native import build as _build

_build.ensure_kquantity()
