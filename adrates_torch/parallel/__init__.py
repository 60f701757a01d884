from .book import (BookAggregate, BookTensors, aggregate_book,
                   aggregate_total_pv, book_pvs, compile_book,
                   compile_book_buckets, make_book_fn, make_bucketed_book_fn,
                   make_pershard_aggregate_fn, make_sharded_book_fn,
                   merge_aggregates, shard_book, tile_book)
from .multibook import (BookInputs, ClampSlots, ColRows, CurveBasket,
                        MultiBook, MultiBookAggregate, MultiBookRows,
                        MultiBookShard, aggregate_total, book_inputs,
                        compile_multibook, make_multibook_fn,
                        make_multibook_speed_fn, make_per_trade_delta_fn,
                        make_per_trade_gamma_fn, make_sharded_multibook_fn,
                        make_staged_multibook_fn, shard_multibook,
                        tile_multibook, trade_pvs, warmup_multibook)
from .pertrade_blocks import (GammaBlockGroup, dense_from_block,
                              make_per_trade_gamma_blocks_fn)
from .pertrade_sharded import (make_sharded_per_trade_delta_fn,
                               make_sharded_per_trade_gamma_blocks_fn,
                               make_sharded_per_trade_gamma_fn)
