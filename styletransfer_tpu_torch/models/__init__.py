"""Models: the image transform net."""
