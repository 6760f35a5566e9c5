# pygame-dependent modules are imported lazily; see interactive.py / gui.py
__all__ = ["interactive", "gui"]
