"""y-sync protocol, Awareness and the multi-tenant server loop (PyTorch
port of `ytpu.sync`: protocol, awareness, the server's session loop and
the device-authoritative `DeviceSyncServer`)."""

from .awareness import Awareness, AwarenessUpdate, AwarenessUpdateEntry
from .protocol import (
    Message,
    PermissionDenied,
    Protocol,
    SyncMessage,
    UnsupportedMessage,
    message_reader,
)
from .server import Session, SyncServer


def __getattr__(name: str):
    # lazy: DeviceSyncServer pulls torch and the batch engine; the host
    # control plane (protocol, Awareness, SyncServer) imports without it
    if name == "DeviceSyncServer":
        from .device_server import DeviceSyncServer

        return DeviceSyncServer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Awareness",
    "AwarenessUpdate",
    "AwarenessUpdateEntry",
    "Message",
    "SyncMessage",
    "Protocol",
    "message_reader",
    "PermissionDenied",
    "UnsupportedMessage",
    "SyncServer",
    "DeviceSyncServer",
    "Session",
]
