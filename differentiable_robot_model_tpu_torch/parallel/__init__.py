"""Multi-GPU scaling over torch.distributed: meshes, sharded solves and
data-parallel training (`mesh`), and the horizon-sharded Riccati
(`horizon`)."""
