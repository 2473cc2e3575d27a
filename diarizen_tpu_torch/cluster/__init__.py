"""Host-side clustering (numpy/scipy)."""

from diarizen_tpu_torch.cluster.ahc import AgglomerativeClustering, ahc_cluster
from diarizen_tpu_torch.cluster.oracle import OracleClustering
from diarizen_tpu_torch.cluster.vbx import VBxClustering, cluster_vbx, vbx, vbx_setup

__all__ = ["AgglomerativeClustering", "OracleClustering", "VBxClustering", "ahc_cluster",
           "cluster_vbx", "vbx", "vbx_setup"]
