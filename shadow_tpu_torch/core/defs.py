"""Wire/protocol constants.

Values match the reference's definitions.h so simulated byte/packet accounting
is comparable.  The protocol-spec surfaces below are GENERATED from
``spec/protocol_spec.json`` (simgen; `make gen`) — edit the spec, not the
fenced region.
"""

# >>> simgen:begin region=wire-defs spec=293c930bb679 body=8d099a58ba06
# Ethernet/IP framing (reference definitions.h:169-193).
CONFIG_HEADER_SIZE_UDPIPETH = 42    # UDP+IP+ETH header bytes
CONFIG_HEADER_SIZE_TCPIPETH = 66    # TCP+IP+ETH header bytes (with options)
CONFIG_MTU = 1500
CONFIG_DATAGRAM_MAX_SIZE = 65507
CONFIG_TCP_MAX_SEGMENT_SIZE = CONFIG_MTU - (CONFIG_HEADER_SIZE_TCPIPETH - 14)  # 1448

# Interface token bucket (reference network_interface.c:93-95, 207-214).
INTERFACE_REFILL_INTERVAL_NS = 1000000        # 1 ms token refill
INTERFACE_CAPACITY_FACTOR = 1                   # capacity = refill*factor + MTU

# TCP buffer caps (reference definitions.h:109-114).
CONFIG_TCP_WMEM_MAX = 4194304
CONFIG_TCP_RMEM_MAX = 6291456

# TCP retransmit-timer bounds, ms (reference definitions.h:115-131).
CONFIG_TCP_RTO_INIT_MS = 1000
CONFIG_TCP_RTO_MIN_MS = 200
CONFIG_TCP_RTO_MAX_MS = 120000
# <<< simgen:end region=wire-defs

# Hand-kept knobs (not protocol-spec surfaces).
CONFIG_RECEIVE_BATCH_TIME_NS = 10_000_000       # definitions.h:169
CONFIG_TCP_WMEM_MIN = 4096
CONFIG_TCP_WMEM_DEFAULT = 16384
CONFIG_TCP_RMEM_MIN = 4096
CONFIG_TCP_RMEM_DEFAULT = 87380
NET_TCP_HZ_MS = 1000
CONFIG_TCP_DELACK_MIN_MS = NET_TCP_HZ_MS // 25
CONFIG_TCP_DELACK_MAX_MS = NET_TCP_HZ_MS // 5
