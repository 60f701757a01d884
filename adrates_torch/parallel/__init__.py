from .book import (BookAggregate, BookTensors, aggregate_book,
                   aggregate_total_pv, book_pvs, compile_book,
                   compile_book_buckets, make_book_fn, make_bucketed_book_fn,
                   merge_aggregates, tile_book)
from .multibook import (BookInputs, ClampSlots, ColRows, CurveBasket,
                        MultiBook, MultiBookAggregate, MultiBookRows,
                        aggregate_total, book_inputs, compile_multibook,
                        make_multibook_fn, make_multibook_speed_fn,
                        make_per_trade_delta_fn, make_per_trade_gamma_fn,
                        make_staged_multibook_fn, tile_multibook,
                        warmup_multibook)
from .pertrade_blocks import (GammaBlockGroup, dense_from_block,
                              make_per_trade_gamma_blocks_fn)
