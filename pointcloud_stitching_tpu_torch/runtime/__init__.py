"""The streaming runtime of the port: wire protocol, fake camera server,
pipelined multicamera client, the stitched-cloud publisher and viewer, and
their CLIs."""
from .wire import (Codec, Kind, decode_frame, encode_depth_frame,
                   encode_frame, pack_points_i16mm, recv_frame,
                   unpack_points_i16mm)
from .fake_server import FakeCameraServer, synthetic_frames
from .client import CameraIngest, MulticameraClient
from .publisher import CloudPublisher
from .view_cli import StreamViewer

__all__ = [
    "Codec", "Kind", "decode_frame", "encode_depth_frame", "encode_frame",
    "pack_points_i16mm", "recv_frame", "unpack_points_i16mm",
    "FakeCameraServer", "synthetic_frames",
    "CameraIngest", "MulticameraClient", "CloudPublisher", "StreamViewer",
]
