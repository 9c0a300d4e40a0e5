"""Service layer: recipe-driven end-to-end pipelines."""

from .camera_config import camera_config
from .velocimetry import VelocityFlowProcessor, velocity_flow, velocity_flow_subprocess

__all__ = ["velocity_flow", "velocity_flow_subprocess", "VelocityFlowProcessor", "camera_config"]
