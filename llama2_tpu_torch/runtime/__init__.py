from llama2_tpu_torch.runtime.generator import GenerateResult, Generator

__all__ = ["Generator", "GenerateResult"]
