"""Launch of the port: the step builders (``steps``), the end-to-end
training driver (``train``: ``python -m repro_torch.launch.train``), and
distributed launch — device meshes (``mesh``), the sharding rules as
DTensor placements (``sharding``, with ``repro_torch.pspec`` for the
models' activation hints), the dry run of the production meshes on a fake
process group (``dryrun``: ``python -m repro_torch.launch.dryrun``), the
H100 roofline and the step counter (``roofline``) and its report
(``roofline_report``)."""
