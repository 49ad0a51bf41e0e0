from a3t_tpu_torch.text.tokenizer import TokenIDConverter

__all__ = ["TokenIDConverter"]
