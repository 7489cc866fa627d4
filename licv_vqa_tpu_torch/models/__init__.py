"""Models of the port: Idefics-9B (LLaMA decoder with gated cross-attention,
CLIP ViT-H tower, perceiver resampler), Idefics2-8B-base (Mistral decoder,
SigLIP/NaViT tower, perceiver connector) and OpenFlamingo-9B (MPT decoder
with ALiBi and gated cross-attention, CLIP ViT-L tower, perceiver).
Submodules are imported explicitly (``from licv_vqa_tpu_torch.models import
idefics``)."""
