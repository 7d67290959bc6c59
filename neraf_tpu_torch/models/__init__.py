"""Models: vision, acoustic, camera correction, scene grid, 3D ResNet."""
