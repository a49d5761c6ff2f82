"""Rendezvous, collectives and gradient-sync strategies over
``torch.distributed``."""
