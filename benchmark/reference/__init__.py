"""The benchmark's plain reference: plain torch, independent of the
program. It imports nothing of chameleonrt_tpu_torch, chameleonrt_tpu or
jax, and takes nothing the program made: it rebuilds its tables from the
scene generators' own arrays."""
