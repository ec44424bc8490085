"""Device meshes and the sharded query session of the port."""
