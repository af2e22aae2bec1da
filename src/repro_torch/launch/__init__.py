"""Entry points of the port: the serve launcher
(``python -m repro_torch.launch.serve``) and its local multi-process spawn
recipe (``procs``).  Counterpart of ``repro.launch``'s ``serve`` and
``procs``; the training, mesh and cost-analysis launchers come with later
slices (ROADMAP queue 1, items 8 and 9)."""
