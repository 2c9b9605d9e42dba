"""A benchmark at a size the CPU holds: every cell's configuration and
traffic shrunk (decoder H=16, 4 rows, 24-pixel crops, 6 decode steps)."""

from portbench import registry


class TinyBench(registry.Benchmark):
    def config(self, name):
        c = super().config(name)
        c["config"].update(encoder_num_hidden=8, target_embedding_size=4,
                           max_decoder_l=6, batch_size=4)
        return c

    def traffic(self, name):
        t = super().traffic(name)
        t.update(batch=4, width=24, trace_calls=2)
        if t["entry"] == "recognize":
            t.update(pool=2, max_len=6, sample_rows=6)
        return t
