"""Entry points of the port: the serve launcher
(``python -m repro_torch.launch.serve``) and its local multi-process spawn
recipe (``procs``), the training launcher
(``python -m repro_torch.launch.train``), its step functions (``steps``),
the device meshes (``mesh``), and the cost analysis: the counter
(``cost``), the dry-run, roofline and perf probes
(``python -m repro_torch.launch.{dryrun,roofline,perf}``), which count a
step's per-device work on meta tensors over a fake production mesh.
Counterpart of ``repro.launch``."""
