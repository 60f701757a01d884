from .book import BookTensors, book_pvs, compile_book
from .multibook import (BookInputs, ClampSlots, ColRows, CurveBasket,
                        MultiBook, MultiBookAggregate, MultiBookRows,
                        aggregate_total, book_inputs, compile_multibook,
                        make_multibook_fn, tile_multibook)
