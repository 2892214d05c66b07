"""Tri-plane colour field (twin of models/texture_field)."""
from .triplane import (TriplaneColorField, field_forward, fit_and_paint,
                       fit_color_field, get_textured_mesh, triplane_from_jax)
