from .rice import MMTopkRetriever

__all__ = ["MMTopkRetriever"]
