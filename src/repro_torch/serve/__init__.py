from .server import DecodeCore, InferenceServer, Request, ServeConfig

__all__ = ["DecodeCore", "InferenceServer", "Request", "ServeConfig"]
