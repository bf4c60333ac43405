"""Training launch of the port: the step builders (``steps``) and the
end-to-end driver (``train``: ``python -m repro_torch.launch.train``).
Distributed launch (meshes, sharding rules, the dry run, rooflines) is not
ported yet (ROADMAP.md, A11)."""
