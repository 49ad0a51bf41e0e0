from a3t_tpu_torch.text.native_g2p import letter_to_sound
from a3t_tpu_torch.text.tokenizer import TokenIDConverter, build_token_list

__all__ = ["TokenIDConverter", "build_token_list", "letter_to_sound"]
