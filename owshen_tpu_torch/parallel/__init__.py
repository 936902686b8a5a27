"""The mesh layer, after owshen_tpu/parallel/: a single-controller mesh of
shards (mesh.py), the Bailey NTT across it (ntt_dist.py), the sharded
Pippenger MSM (msm_dist.py) and the sharded Merkle trees (merkle_dist.py)."""
