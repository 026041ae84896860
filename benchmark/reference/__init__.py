"""The plain float32 reference of what the benchmark's cells run: the
NCSN++ forward, the PSLD SDE with its Euler--Maruyama step and HSM loss,
and the optimizer (global-norm clip, Adam with warmup, EMA).

It imports nothing of the port and nothing of JAX, and takes nothing the
port has made: its weights and inputs come from the benchmark."""
