from .batch import (
    BatchEncoder, PreparedTopology, device_encode_group, encode_with_topology,
    gathers_to_torch, quantize_positions_host, topology_gathers_np,
    topology_signature,
)

__all__ = ["BatchEncoder", "PreparedTopology", "device_encode_group",
           "encode_with_topology", "gathers_to_torch",
           "quantize_positions_host", "topology_gathers_np",
           "topology_signature"]
