from .elements import LagrangianArray, ElementState  # noqa: F401
