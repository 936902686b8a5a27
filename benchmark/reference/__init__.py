"""The plain reference of every cell: Python integers, NumPy and plain torch.

Nothing here imports the port (`owshen_tpu_torch`), the JAX package or JAX.
The pure-Python pieces are frozen copies of the port's host oracles at
commit c2af7b2 (`owshen_tpu_torch/oracle/`, `groth16/pairing.py`,
`groth16/r1cs.py`, `circuits/`), cut to what a check needs."""
