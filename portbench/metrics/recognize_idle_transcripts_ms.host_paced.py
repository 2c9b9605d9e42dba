"""recognize_idle_transcripts_ms in the host-paced cells that
BENCHMARK.json lists under this name, where it moves
recognize_images_per_s.host_paced."""


def read(run):
    from portbench import registry

    return registry.reader("recognize_idle_transcripts_ms")(run)
