from llama2_tpu_torch.models.llama import forward, init_cache, logits_from_hidden

__all__ = ["forward", "init_cache", "logits_from_hidden"]
