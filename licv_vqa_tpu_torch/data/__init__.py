from .prompt import PromptManager
from .tokenizer import WhitespaceTokenizer, load_hf_tokenizer
from .processor import ImageTransform, PromptProcessor
from .collator import collate_icv_batch
from .datasets import CaptionDataset, VQADataset

__all__ = [
    "PromptManager",
    "WhitespaceTokenizer",
    "load_hf_tokenizer",
    "ImageTransform",
    "PromptProcessor",
    "collate_icv_batch",
    "CaptionDataset",
    "VQADataset",
]
