from .book import BookTensors, book_pvs, compile_book
from .multibook import (BookInputs, ClampSlots, ColRows, CurveBasket,
                        MultiBook, MultiBookAggregate, MultiBookRows,
                        aggregate_total, book_inputs, compile_multibook,
                        make_multibook_fn, make_per_trade_delta_fn,
                        make_per_trade_gamma_fn, make_staged_multibook_fn,
                        tile_multibook, warmup_multibook)
from .pertrade_blocks import (GammaBlockGroup, dense_from_block,
                              make_per_trade_gamma_blocks_fn)
