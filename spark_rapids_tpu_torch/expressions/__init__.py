"""Expression DSL surface of the port (the analog of pyspark.sql.functions)."""
from spark_rapids_tpu_torch.expressions.core import (
    Alias,
    BoundReference,
    Col,
    EvalContext,
    Expression,
    Literal,
    col,
    lit,
)
from spark_rapids_tpu_torch.expressions.arithmetic import (
    Abs, Add, Divide, IntegralDivide, Multiply, Remainder, Subtract,
    UnaryMinus)
from spark_rapids_tpu_torch.expressions.predicates import (
    And,
    Coalesce,
    EqualNullSafe,
    EqualTo,
    GreaterThan,
    GreaterThanOrEqual,
    In,
    IsNotNull,
    IsNull,
    LessThan,
    LessThanOrEqual,
    Not,
    Or,
)
from spark_rapids_tpu_torch.expressions.strings import (
    Ascii, BitLength, Concat, ConcatStrings, ConcatWs, Contains, Empty2Null,
    EndsWith, InitCap, Left, Length, Like, Lower, Lpad, LTrim, OctetLength,
    Reverse, Right, RLike, Rpad, RTrim, StartsWith, StringInstr,
    StringLocate, StringRepeat, StringReplace, Substring, Translate, Trim,
    Upper)
from spark_rapids_tpu_torch.expressions.casts import Cast
from spark_rapids_tpu_torch.expressions.conditional import (
    CaseWhen, Greatest, If, Least, NullIf, Nvl2)
from spark_rapids_tpu_torch.expressions.datetime import (
    AddMonths, DateAdd, DateDiff, DateFromUnixDate, DateSub, DayOfMonth,
    DayOfWeek, DayOfYear, FromUtcTimestamp, Hour, LastDay, MakeDate,
    MicrosToTimestamp, MillisToTimestamp, Minute, Month, MonthsBetween,
    NextDay, Quarter, Second, SecondsToTimestamp, ToUtcTimestamp, TruncDate,
    UnixDate, UnixMicros, UnixMillis, UnixSeconds, WeekOfYear, Year,
    from_utc_timestamp, to_utc_timestamp)
from spark_rapids_tpu_torch.expressions.hashing import (
    BloomFilterMightContain, HiveHash, Murmur3Hash, XxHash64, hash, hive_hash,
    xxhash64)
from spark_rapids_tpu_torch.expressions.aggregates import (
    ApproximateCountDistinct, Average, BitAndAgg, BitOrAgg, BitXorAgg,
    BoolAnd, BoolOr, Count, First, Last, Max, MaxBy, Min, MinBy, StddevPop,
    StddevSamp, Sum, VariancePop, VarianceSamp, approx_count_distinct, avg,
    bit_and, bit_or, bit_xor, count, first, last, max_, max_by, min_, min_by,
    stddev, stddev_pop, sum_, var_pop, var_samp)
from spark_rapids_tpu_torch.expressions.window import (
    CumeDist, DenseRank, FirstValue, Lag, LastValue, Lead, NthValue, Ntile,
    PercentRank, Rank, RowNumber, WindowExpression, WindowFrame, WindowSpec,
    over)

__all__ = [
    "ApproximateCountDistinct", "BloomFilterMightContain",
    "approx_count_distinct",
    "Abs", "AddMonths", "DateAdd", "DateDiff", "DateFromUnixDate", "DateSub",
    "DayOfMonth", "DayOfWeek", "DayOfYear", "FromUtcTimestamp", "Greatest",
    "HiveHash", "Hour", "IntegralDivide", "LastDay", "Least", "MakeDate",
    "MicrosToTimestamp", "MillisToTimestamp", "Minute", "Month",
    "MonthsBetween", "Murmur3Hash", "NextDay", "NullIf", "Nvl2", "Quarter",
    "Remainder", "Second", "SecondsToTimestamp", "ToUtcTimestamp",
    "TruncDate", "UnaryMinus", "UnixDate", "UnixMicros", "UnixMillis",
    "UnixSeconds", "WeekOfYear", "XxHash64", "Year", "from_utc_timestamp",
    "hash", "hive_hash", "to_utc_timestamp", "xxhash64",
    "Add", "Alias", "And", "Ascii", "Average", "BitAndAgg", "BitLength",
    "BitOrAgg", "BitXorAgg", "BoolAnd", "BoolOr", "BoundReference",
    "CaseWhen", "Cast", "Coalesce", "Col", "Concat", "ConcatStrings", "ConcatWs",
    "Contains", "Count", "CumeDist", "DenseRank", "Divide", "Empty2Null",
    "EndsWith", "EqualNullSafe", "EqualTo", "EvalContext", "Expression", "First", "FirstValue",
    "GreaterThan", "GreaterThanOrEqual", "If", "In", "InitCap",
    "IsNotNull", "IsNull", "LTrim",
    "Lag", "Last", "LastValue", "Lead", "Left", "Length", "LessThan",
    "LessThanOrEqual", "Like", "Literal", "Lower", "Lpad", "Max", "MaxBy",
    "Min", "MinBy", "Multiply", "Not", "NthValue", "Ntile", "OctetLength",
    "Or", "PercentRank", "RLike", "RTrim", "Rank", "Reverse", "Right",
    "RowNumber", "Rpad", "StartsWith", "StddevPop", "StddevSamp",
    "StringInstr", "StringLocate", "StringRepeat", "StringReplace",
    "Substring", "Subtract", "Sum", "Translate", "Trim", "Upper",
    "VariancePop", "VarianceSamp", "WindowExpression", "WindowFrame",
    "WindowSpec", "avg", "bit_and", "bit_or", "bit_xor", "col", "count",
    "first", "last", "lit", "max_", "max_by", "min_", "min_by", "over",
    "stddev", "stddev_pop", "sum_", "var_pop", "var_samp",
]
