"""Training substrate of the port: AdamW (``optimizer``), the train step
(``trainer``), Sector-backed checkpoints (``checkpoint``) and elastic
re-ranking (``elastic``)."""
