"""Training substrate of the port: for now only elastic re-ranking
(:mod:`repro_torch.train.elastic`); the optimizer, the trainer and
Sector-backed checkpoints follow with the port of ``models/``."""
