"""Editable rendering: object boxes, the edit renderer and its demo CLI
(`python -m object_nerf_torch.edit`)."""
