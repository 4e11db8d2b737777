"""Hand-written CUDA kernels of the port (sources in
``paddle_tpu_torch/csrc``) with their plain PyTorch versions.

Every wrapper takes the plain version for tensors on the CPU and
launches its kernel for CUDA tensors (or raises); nothing falls back.
``launch_counts`` counts kernel launches per wrapper — a plain integer
bumped right after each successful launch, so a run can show that its
main path went through the kernels.
"""
launch_counts = {"ragged_paged_attention": 0, "paged_decode_attention": 0,
                 "paged_verify_attention": 0, "norm_matmul": 0,
                 "matmul_residual": 0, "flash_attention_fwd": 0,
                 "flash_attention_dq": 0, "flash_attention_dkv": 0,
                 "moe_gather_gmm_swiglu": 0, "moe_scatter_gmm": 0,
                 "moe_gmm": 0}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


__all__ = ["launch_counts", "reset_launch_counts"]
