from a3t_tpu_torch.text.tokenizer import TokenIDConverter, build_token_list

__all__ = ["TokenIDConverter", "build_token_list"]
