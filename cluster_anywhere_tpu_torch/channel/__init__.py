"""Typed single-writer / multi-reader channels (analogue of the reference's
ray.experimental.channel: shared_memory_channel.py:151 Channel,
BufferedSharedMemoryChannel:534, IntraProcessChannel),
backed by versioned shared-memory segments instead of mutable plasma objects
(reference C++ experimental_mutable_object_manager.h:49).

These are the zero-RPC transport under compiled DAGs: a writer publishes a new
version in place; readers ack.  Tensor payloads cross processes via
device_transport: each CUDA leaf copied once to the host and scatter-written
out of band, landed on the consumer's device (DTensor leaves with their
placements); in-graph transfers ride torch.distributed (parallel/).
"""

from .device_transport import (
    DeviceEnvelope,
    pack_device_value,
    set_transfer_mesh,
    unpack_device_value,
)
from .shm_channel import (
    BufferedShmChannel,
    ChannelClosedError,
    ChannelInterface,
    IntraProcessChannel,
    ShmChannel,
)

__all__ = [
    "ChannelInterface",
    "ShmChannel",
    "BufferedShmChannel",
    "IntraProcessChannel",
    "ChannelClosedError",
    "DeviceEnvelope",
    "pack_device_value",
    "unpack_device_value",
    "set_transfer_mesh",
]
