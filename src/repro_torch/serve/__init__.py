from .fleet import Fleet, FleetConfig, ModelWorker, Router
from .server import DecodeCore, InferenceServer, Request, ServeConfig

__all__ = ["DecodeCore", "Fleet", "FleetConfig", "InferenceServer", "ModelWorker", "Request", "Router", "ServeConfig"]
