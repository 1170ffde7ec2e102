"""Published peaks of the cards the benchmark runs on.

NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data sheet, at the full power
limit of 700 W: 3.35 TB/s of HBM bandwidth and 67 TFLOP/s of float32
outside the tensor cores (the auction's comparisons and adds).
"""

H100 = {"hbm_bytes_per_s": 3.35e12, "f32_ops_per_s": 67e12}


def least_seconds(work: tuple, peak: dict) -> float:
    """The least time a problem of ``(bytes, operations)`` needs: the
    larger of its bytes at the bandwidth and its operations at the
    float32 rate."""
    nbytes, ops = work
    return max(nbytes / peak["hbm_bytes_per_s"], ops / peak["f32_ops_per_s"])
