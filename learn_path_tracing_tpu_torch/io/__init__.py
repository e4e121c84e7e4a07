"""Host-side scene I/O (numpy): OBJ meshes, OpenEXR images, texture atlases."""
