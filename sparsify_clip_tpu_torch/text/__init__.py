from sparsify_clip_tpu_torch.text.tokenizer import CLIPTokenizer, get_tokenizer

__all__ = ["CLIPTokenizer", "get_tokenizer"]
