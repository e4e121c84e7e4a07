from .mesh import (Mesh, make_mesh, render_hybrid_multichip, render_multichip,
                   render_persistent_multichip, render_sharded)

__all__ = ["Mesh", "make_mesh", "render_hybrid_multichip", "render_multichip",
           "render_persistent_multichip", "render_sharded"]
