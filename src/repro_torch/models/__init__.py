from .model import decode_step, init_cache, init_params, model_dtype, prefill

__all__ = ["init_params", "init_cache", "prefill", "decode_step", "model_dtype"]
