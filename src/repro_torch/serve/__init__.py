from repro_torch.serve.engine import Request, ServeEngine, ServeReport

__all__ = ["ServeEngine", "ServeReport", "Request"]
