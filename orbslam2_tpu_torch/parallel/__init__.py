"""The distributed solvers on torch.distributed: the Schur BA sharded by point
owner (dist_ba.py), the pose graph sharded by edges (dist_pgo.py), and the
process-group plumbing, the problem broadcast and the global BA's peer loop
(multihost.py). The reductions themselves are in collectives.py, which the
solvers of ops/ call."""
