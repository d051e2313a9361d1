"""Pose initialisation from matches (torch port of sparf_tpu/colmap_init)."""
