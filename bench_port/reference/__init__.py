"""bench_port.reference"""
