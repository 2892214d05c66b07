from .sample import sample_colored_pc_from_mesh, sample_from_obj

__all__ = ["sample_colored_pc_from_mesh", "sample_from_obj"]
