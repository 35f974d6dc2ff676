"""Mesh tools: marching tetrahedra and the mesh-extraction CLI
(`python -m object_nerf_torch.tools.extract_mesh`)."""
