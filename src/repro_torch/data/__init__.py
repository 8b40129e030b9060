"""Sector-backed data pipeline: dataset slices live in the storage cloud;
segments are scheduled onto hosts with the Sphere locality rules.

Port of ``repro/data``: copies of its numpy modules."""

from repro_torch.data.pipeline import SectorDataPipeline, upload_token_dataset
from repro_torch.data.synthetic import synthetic_tokens

__all__ = ["SectorDataPipeline", "upload_token_dataset", "synthetic_tokens"]
