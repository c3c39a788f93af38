from llama2_tpu_torch.tokenizer.tokenizer import BOS, EOS, Tokenizer

__all__ = ["Tokenizer", "BOS", "EOS"]
