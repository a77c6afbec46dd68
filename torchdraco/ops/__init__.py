"""Tensor ops of the port: the fused encode step (K1, K2) and the float
side of the single-mesh routes, the multi-lane rANS coder in its words
(K3) and dense (K4) forms, and the lane decoder (D1), each kernel a CUDA
kernel beside its plain PyTorch twin."""

from .device import (
    bincount_kernel, default_hist_bins, dequantize_kernel, encode_step,
    encode_step_chunk, encode_step_from_q, encode_step_from_q_cuda,
    encode_step_stream_sharded,
    histogram, histogram_form, histogram_smem_bins, minmax_chunk_kernel,
    parallelogram_predict_kernel, predict_form, predict_residual,
    predict_residual_ref, predict_tiles, quantize_kernel,
    quantize_rows_kernel, quantized_range_chunk_kernel, unpack12_kernel,
    unzigzag_kernel, upload_layout_of, widen, wrapped_difference_kernel,
    zigzag_kernel,
)
from .rans_lanes import (
    encode_direct_coded_streams_device, encode_group_entropy_device,
    encode_streams_device, normalize_tables, rans_decode_lanes,
    rans_decode_lanes_ref, rans_encode_lanes, rans_scan_dense,
    rans_scan_dense_ref, rans_words_scan, rans_words_scan_ref,
)

KERNEL_WRAPPERS = (predict_residual, histogram, rans_words_scan,
                   rans_scan_dense, rans_decode_lanes)


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in KERNEL_WRAPPERS:
        fn.n_launches = 0
    for fn, name in ((predict_residual, "n_launches_by_layout"),
                     (predict_residual, "n_launches_by_form"),
                     (histogram, "n_launches_by_form")):
        setattr(fn, name, dict.fromkeys(getattr(fn, name), 0))


__all__ = [
    "KERNEL_WRAPPERS", "bincount_kernel", "default_hist_bins",
    "dequantize_kernel", "encode_direct_coded_streams_device",
    "encode_group_entropy_device", "encode_step", "encode_step_chunk",
    "encode_step_from_q", "encode_step_from_q_cuda",
    "encode_step_stream_sharded",
    "encode_streams_device", "histogram", "histogram_form",
    "histogram_smem_bins", "minmax_chunk_kernel", "normalize_tables",
    "parallelogram_predict_kernel", "predict_form", "predict_residual",
    "predict_residual_ref", "predict_tiles", "quantize_kernel",
    "quantize_rows_kernel",
    "quantized_range_chunk_kernel", "rans_decode_lanes",
    "rans_decode_lanes_ref", "rans_encode_lanes", "rans_scan_dense",
    "rans_scan_dense_ref", "rans_words_scan", "rans_words_scan_ref",
    "reset_launch_counts", "unpack12_kernel", "unzigzag_kernel",
    "upload_layout_of", "widen", "wrapped_difference_kernel",
    "zigzag_kernel",
]
