"""Tools: marching tetrahedra and the mesh-extraction CLI
(`python -m object_nerf_torch.tools.extract_mesh`), the scene viewer
(`visualize.py`, `html_viewer.py`, `python -m
object_nerf_torch.tools.scene_visualizer`) and the instance-map inspector
(`python -m object_nerf_torch.tools.visualize_instance_2d`)."""
