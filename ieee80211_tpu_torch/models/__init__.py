from .pipeline import RxPipeline, RxStep, tables_from_numpy

__all__ = ["RxPipeline", "RxStep", "tables_from_numpy"]
