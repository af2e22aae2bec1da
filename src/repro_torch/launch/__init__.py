"""Entry points of the port: the serve launcher
(``python -m repro_torch.launch.serve``) and its local multi-process spawn
recipe (``procs``), the training launcher
(``python -m repro_torch.launch.train``), its step functions (``steps``)
and the device meshes (``mesh``).  Counterpart of ``repro.launch``'s
``serve``, ``procs``, ``train``, ``steps`` and ``mesh``; the cost-analysis
modules come with a later slice (ROADMAP queue 1, item 9)."""
