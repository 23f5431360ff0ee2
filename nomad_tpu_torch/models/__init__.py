from .matrix import ClusterMatrix, BUCKETS, bucket_size

__all__ = ["ClusterMatrix", "BUCKETS", "bucket_size"]
