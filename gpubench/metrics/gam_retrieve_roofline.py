"""The fused retrieval kernel's share of its roofline, in %: the least time
the card could take for the window's calls (``counts.gam_retrieve_work``
against ``peaks.json``), over the device time of the kernels of
``csrc/gam_retrieve.cu`` in the traced window."""
from gpubench.counts import gam_retrieve_work
from gpubench.reference.phi import parse_tree_dim

#: the kernels of the program's ``csrc/gam_retrieve.cu``, by name
KERNELS = r"^(void )?(pack|skip|tile|wide|merge)_kernel\b"


def read(run, name):
    prof, peaks = run.profile, run.peaks()
    if prof is None or peaks is None or not run.launches:
        return None
    device_s = prof.kernel_s(KERNELS)
    if device_s <= 0.0:
        return None
    k = int(run.config["gam"]["k"])
    kappa = int(run.config["spec"]["kappa"])
    per_request = run.launches / len(run.queries)
    ops_s = bytes_s = bound_s = 0.0
    for q, scored in zip(run.queries, run.n_scored):
        if scored is None:
            continue
        ops, n_bytes = gam_retrieve_work(
            q, k, parse_tree_dim(k), kappa, run.n_live, scored, per_request)
        ops_s += ops / peaks["f32_flops"]
        bytes_s += n_bytes / peaks["hbm_bytes_per_s"]
        bound_s += max(ops / peaks["f32_flops"],
                       n_bytes / peaks["hbm_bytes_per_s"])
    run.notes[name] = (
        f"bound by {'operations' if ops_s >= bytes_s else 'bytes'}: "
        f"operations {ops_s:.6g} s, bytes {bytes_s:.6g} s, bound "
        f"{bound_s:.6g} s, kernels {device_s:.6g} s")
    return 100.0 * bound_s / device_s
