"""Device compute of the port: hand-written CUDA kernels (``csrc/``), their
build (``build``), wrappers with plain versions (``hopper_kernels``), and
the serving routes built on them (``als``, ``topk``)."""
