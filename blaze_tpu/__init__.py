"""blaze_tpu: a ZK primitive framework on JAX/XLA for NVIDIA GPUs.

Re-implements the capabilities of ingonyama-zk/blaze (FPGA host driver for
MSM / NTT / Poseidon user logic) as an actual compute framework:
multi-limb Montgomery field arithmetic, elliptic-curve ops, Pippenger MSM,
large NTTs and Poseidon Merkle trees as JAX programs that XLA compiles, with
a five-phase client lifecycle (initialize / set_data / start_process /
wait_result / result) mirroring the reference's DriverPrimitive trait
(`/root/reference/src/driver_client/dclient.rs:24-46`) and a shard_map
distribution layer in place of the reference's single-card DMA transport.
"""

__version__ = "0.1.0"
