"""Host-side clustering (numpy/scipy)."""

from diarizen_tpu_torch.cluster.ahc import AgglomerativeClustering, ahc_cluster

__all__ = ["AgglomerativeClustering", "ahc_cluster"]
