from deequ_tpu_torch.parallel.mesh import (
    Mesh,
    current_mesh,
    default_mesh,
    set_mesh,
    use_mesh,
    virtual_mesh,
)

__all__ = ["Mesh", "current_mesh", "default_mesh", "set_mesh", "use_mesh", "virtual_mesh"]
