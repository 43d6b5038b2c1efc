from .model import decode_step, forward_train, init_cache, init_params, loss_fn, model_dtype, prefill

__all__ = ["init_params", "forward_train", "loss_fn", "init_cache", "prefill", "decode_step", "model_dtype"]
