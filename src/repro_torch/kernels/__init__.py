"""Hand-written Hopper kernels, each beside its plain PyTorch version."""


def launch_counts() -> dict:
    """Every kernel wrapper's launches since its last reset, by kernel."""
    from .flash_attention import ops as fa_ops
    from .fusion_loss import ops as fl_ops
    from .jcsba_solver import ops as js_ops
    from .ssd_scan import ops as ssd_ops
    return {**fl_ops.launch_counts(), **fa_ops.launch_counts(),
            **ssd_ops.launch_counts(), **js_ops.launch_counts()}
