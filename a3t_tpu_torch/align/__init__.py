from a3t_tpu_torch.align.native import NativeAligner, align_corpus

__all__ = ["NativeAligner", "align_corpus"]
