"""Offline data-preparation CLIs (layer L1 of the reference), own copies of
`object_nerf_tpu/data_prep/`:

* sens_reader      — parse ScanNet `.sens` captures and export colour, depth,
                     poses and intrinsics (data_preparation/scannet_sens_reader/).
* convert_nerf     — emit NeRF-style transforms_{train,test,val,full}.json and
                     resized images (convert_to_nerf_style_data.py).
* scannet_labels   — per-instance axis-aligned boxes and vertex labels of a
                     ScanNet scan (data_preparation/scannet_preprocess/).

Depth, poses, intrinsics and labels need numpy only; colour is JPEG, which
`sens_reader` decodes with imageio and `convert_nerf` with cv2, both imported
when colour is asked for.
"""
