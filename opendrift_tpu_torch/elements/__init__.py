from .elements import LagrangianArray, ElementState, PassiveTracer  # noqa: F401,E501
