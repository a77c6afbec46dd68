from .batch import (
    BatchEncoder, PreparedTopology, device_encode_group, encode_with_topology,
    gathers_to_torch, quantize_positions_host, topology_gathers_np,
    topology_signature,
)
from .decode_batch import BatchDecoder

__all__ = ["BatchDecoder", "BatchEncoder", "PreparedTopology",
           "device_encode_group", "encode_with_topology", "gathers_to_torch",
           "quantize_positions_host", "topology_gathers_np",
           "topology_signature"]
