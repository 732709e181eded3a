from repro_torch.comm.exchange import (Exchange, default_exchange,
                                      get_exchange)

__all__ = ["Exchange", "default_exchange", "get_exchange"]
