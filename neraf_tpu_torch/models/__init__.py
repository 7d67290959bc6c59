"""Models: acoustic model, scene grid, 3D ResNet."""
