"""Models of the port: the Idefics-9B stack (LLaMA decoder with gated
cross-attention, CLIP ViT-H tower, perceiver resampler).  Submodules are
imported explicitly (``from licv_vqa_tpu_torch.models import idefics``)."""
