"""Entry points of the port: the serve launcher
(``python -m repro_torch.launch.serve``) and its local multi-process spawn
recipe (``procs``), the training launcher
(``python -m repro_torch.launch.train``) and its step functions
(``steps``).  Counterpart of ``repro.launch``'s ``serve``, ``procs``,
``train`` and ``steps``; the mesh and cost-analysis modules come with later
slices (ROADMAP queue 1, items 8 and 9)."""
