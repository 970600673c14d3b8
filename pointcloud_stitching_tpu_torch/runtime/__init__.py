"""The streaming runtime of the port: wire protocol, fake camera server,
pipelined multicamera client and their CLIs (the publisher and viewer are
not ported yet)."""
from .wire import (Codec, Kind, decode_frame, encode_depth_frame,
                   encode_frame, pack_points_i16mm, recv_frame,
                   unpack_points_i16mm)
from .fake_server import FakeCameraServer, synthetic_frames
from .client import CameraIngest, MulticameraClient

__all__ = [
    "Codec", "Kind", "decode_frame", "encode_depth_frame", "encode_frame",
    "pack_points_i16mm", "recv_frame", "unpack_points_i16mm",
    "FakeCameraServer", "synthetic_frames",
    "CameraIngest", "MulticameraClient",
]
