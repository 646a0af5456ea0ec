"""bench_port.lib"""
