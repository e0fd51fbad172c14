"""Detection metrics: nuScenes, KITTI and Waymo protocols."""
